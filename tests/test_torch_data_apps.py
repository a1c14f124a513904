"""The port's MNIST, Adult and featurizer apps and their loaders, against
the JAX package's.

Data is written here by each package's `write_synthetic` (IDX files for
MNIST, a CSV for Adult, CIFAR binaries for the featurizer), from seeds.
- The loaders equal the JAX package's (pixels, labels, features, vocab).
- Each app's `main()` against the JAX app's `main()`, from the JAX
  package's init: per-round losses within rtol 1e-4 (matrix and
  convolution sums run in another order, the tolerance of
  `test_torch_apps.py::test_train_matches_the_jax_train`) and test
  accuracies equal.
- The featurizer's features from one `.caffemodel` equal the JAX
  featurizer's within rtol 1e-4 + atol 1e-6, and so do its `--graph`
  features (the second backend: a GraphDef JSON and a weights npz) of a
  hidden node.
- Each CLI runs with `--device cpu`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sparknet_tpu.apps import adult_app as jax_adult_app
from sparknet_tpu.apps import featurizer_app as jax_featurizer_app
from sparknet_tpu.apps import mnist_app as jax_mnist_app
from sparknet_tpu.apps.train_loop import resolve_spec as jax_resolve_spec
from sparknet_tpu.data import adult as jax_adult
from sparknet_tpu.data import mnist as jax_mnist
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.zoo import cifar10_quick as jax_cifar10_quick

from sparknet_tpu_torch.apps import adult_app, featurizer_app, mnist_app
from sparknet_tpu_torch.data import adult, mnist
from sparknet_tpu_torch.data.cifar import write_synthetic as write_cifar
from sparknet_tpu_torch.model.net import CompiledNet, params_from_jax
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from test_torch_train import jax_params, to_port_spec

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist")
    mnist.write_synthetic(str(d), n_train=64, n_test=16, seed=0)
    return d


@pytest.fixture(scope="module")
def adult_csv(tmp_path_factory):
    p = tmp_path_factory.mktemp("adult") / "adult.data"
    adult.write_synthetic(str(p), n=120, seed=0)
    return p


def _records(workdir):
    (path,) = Path(workdir).glob("training_metrics_*.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def _held(got, want, n_rounds):
    gl = [x["loss"] for x in got if "loss" in x]
    wl = [x["loss"] for x in want if "loss" in x]
    assert len(gl) == len(wl) == n_rounds
    assert all(abs(g - w) <= 1e-4 * abs(w) for g, w in zip(gl, wl)), (gl, wl)
    ga = [x["test_accuracy"] for x in got if "test_accuracy" in x]
    assert ga and ga == [x["test_accuracy"] for x in want
                         if "test_accuracy" in x]


def test_the_loaders_are_the_jax_packages(mnist_dir, adult_csv, tmp_path):
    got, want = mnist.MnistLoader(str(mnist_dir)), \
        jax_mnist.MnistLoader(str(mnist_dir))
    for k in ("train_images", "train_labels", "test_images", "test_labels"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    mnist.write_synthetic(str(tmp_path / "a"), n_train=8, n_test=4, seed=3)
    jax_mnist.write_synthetic(str(tmp_path / "b"), n_train=8, n_test=4,
                              seed=3)
    for name in os.listdir(tmp_path / "a"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()
    with pytest.raises(ValueError, match="bad magic"):
        mnist.read_idx_labels(str(mnist_dir / "train-images-idx3-ubyte"))
    got, want = adult.AdultLoader(str(adult_csv)), \
        jax_adult.AdultLoader(str(adult_csv))
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.vocab == want.vocab


def _from_jax_init(monkeypatch, jspec):
    tnet = CompiledNet.compile(to_port_spec(jspec))
    start = params_from_jax(tnet, jax_params(JaxCompiledNet.compile(jspec)),
                            torch.device("cpu"))
    monkeypatch.setattr(ParallelTrainer, "init_state",
                        lambda self, seed=0: self.state_from_params(start))


MNIST_OVERRIDES = ("max_rounds=3", "tau=2", "local_batch=8", "eval_every=2",
                   "eval_batch=16")


def test_the_mnist_app_matches_the_jax_app(mnist_dir, tmp_path,
                                           monkeypatch):
    jax_mnist_app.main(["--data-dir", str(mnist_dir), *MNIST_OVERRIDES,
                        f"workdir={tmp_path / 'jax'}", "n_devices=1",
                        "trainer_impl=shard_map"])
    jcfg = jax_mnist_app.default_config().with_overrides(*MNIST_OVERRIDES)
    _from_jax_init(monkeypatch, jax_resolve_spec(
        jcfg, data=(8, 1, 28, 28), label=(8, 1)))
    mnist_app.main(["--device", "cpu", "--data-dir", str(mnist_dir),
                    *MNIST_OVERRIDES, f"workdir={tmp_path / 'port'}"])
    _held(_records(tmp_path / "port"), _records(tmp_path / "jax"), 3)


ADULT_OVERRIDES = ("max_rounds=4", "tau=2", "local_batch=8", "eval_every=2",
                   "eval_batch=24")


def test_the_adult_app_matches_the_jax_app(adult_csv, tmp_path,
                                           monkeypatch):
    jax_adult_app.main(["--data", str(adult_csv), *ADULT_OVERRIDES,
                        f"workdir={tmp_path / 'jax'}", "n_devices=1",
                        "trainer_impl=shard_map"])
    n_features = jax_adult.AdultLoader(str(adult_csv)).features.shape[1]
    _from_jax_init(monkeypatch, jax_adult_app.adult_net(8, n_features))
    adult_app.main(["--device", "cpu", "--data", str(adult_csv),
                    *ADULT_OVERRIDES, f"workdir={tmp_path / 'port'}"])
    _held(_records(tmp_path / "port"), _records(tmp_path / "jax"), 4)


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar")
    write_cifar(str(d), n_per_file=20)
    return d


def test_the_featurizer_matches_the_jax_featurizer(cifar_dir, tmp_path):
    weights = str(tmp_path / "w.caffemodel")
    src = JaxNet(jax_cifar10_quick(batch=50))
    src.save_weights(weights)
    jax_featurizer_app.main(["--data-dir", str(cifar_dir), "--weights",
                             weights, "--batch", "50", "--blob", "ip1",
                             "--out", str(tmp_path / "jax.npz")])
    featurizer_app.main(["--device", "cpu", "--data-dir", str(cifar_dir),
                         "--weights", weights, "--batch", "50", "--blob",
                         "ip1", "--out", str(tmp_path / "port.npz")])
    want = np.load(tmp_path / "jax.npz")["features"]
    got = np.load(tmp_path / "port.npz")["features"]
    assert got.shape == want.shape == (100, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # --graph: a small conv graph (NHWC placeholder; the loader's NCHW
    # pixels are recognised and transposed by both GraphNets) and a
    # weights npz, features of a hidden node
    from sparknet_tpu.backend import GraphNet as JaxGraphNet
    from sparknet_tpu_torch.backend import GraphBuilder
    r = np.random.default_rng(3)
    g = GraphBuilder("feat")
    g.placeholder("data", (50, 32, 32, 3))
    g.placeholder("label", (50, 1), dtype="int32")
    g.variable("c_w", 0.1 * r.standard_normal((3, 3, 3, 4)))
    g.variable("c_b", np.zeros(4))
    x = g.relu("relu1", g.bias_add("cb", g.conv2d("c", "data", "c_w",
                                                  stride=2), "c_b"))
    x = g.flatten("flat", g.max_pool("pool", x))
    g.variable("f_w", 0.1 * r.standard_normal((8 * 8 * 4, 10)))
    logits = g.matmul("logits", x, "f_w")
    graph = g.finalize(loss=g.sparse_softmax_ce("loss", logits, "label"))
    gpath, wpath = str(tmp_path / "g.json"), str(tmp_path / "gw.npz")
    graph.save(gpath)
    from sparknet_tpu_torch.model.weights import WeightCollection
    src = JaxGraphNet(graph)
    names = src.get_weights().layer_names
    # weights the file's init does not hold
    WeightCollection({v: [0.1 * r.standard_normal(src.variables[v].shape)]
                      for v in names}, names).save(wpath)
    for fn, name, extra in ((jax_featurizer_app.main, "gjax", []),
                            (featurizer_app.main, "gport",
                             ["--device", "cpu"])):
        fn(extra + ["--data-dir", str(cifar_dir), "--graph", gpath,
                    "--weights", wpath, "--batch", "50", "--blob", "relu1",
                    "--out", str(tmp_path / f"{name}.npz")])
    want = np.load(tmp_path / "gjax.npz")["features"]
    got = np.load(tmp_path / "gport.npz")["features"]
    assert got.shape == want.shape == (100, 16, 16, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def _cli(tmp_path, module, *args):
    env = dict(os.environ, SPARKNET_TPU_HOME=str(tmp_path))
    r = subprocess.run([sys.executable, "-m",
                        f"sparknet_tpu_torch.apps.{module}", "--device",
                        "cpu", *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


@pytest.mark.parametrize("app", ["mnist_app", "adult_app"])
def test_the_training_clis_run_on_the_cpu(app, mnist_dir, adult_csv,
                                          tmp_path):
    data = (["--data-dir", str(mnist_dir)] if app == "mnist_app"
            else ["--data", str(adult_csv)])
    _cli(tmp_path, app, *data, "max_rounds=2", "tau=2", "local_batch=8",
         "eval_every=1", "eval_batch=16", f"workdir={tmp_path}")
    losses = [x for x in _records(tmp_path) if "loss" in x]
    assert [x["step"] for x in losses] == [0, 1]
    assert all(np.isfinite(x["loss"]) and x["nonfinite"] == 0
               for x in losses)


def test_the_featurizer_cli_runs_on_the_cpu(cifar_dir, tmp_path):
    out = tmp_path / "f.npz"
    r = _cli(tmp_path, "featurizer_app", "--data-dir", str(cifar_dir),
             "--batch", "40", "--out", str(out))
    assert "wrote (80, 64) features" in r.stdout
    assert np.isfinite(np.load(out)["features"]).all()
