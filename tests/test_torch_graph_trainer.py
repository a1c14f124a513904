"""The port's GraphTrainer and the graph apps against the JAX package's.

- Two gloo ranks (`tests/torch_graph_worker.py`, spawned, joined through a
  FileStore) against the JAX `GraphTrainer` on a CPU mesh of two, on the
  builder's mnist graph (native `Train` node: rank-local slots) and on an
  imported TF graph (`tests/test_torch_tf_import.py:_tf_graph_bytes`:
  `<var>/Momentum` variables, an int32 global step, an exp-decay lr
  subgraph), τ = 2, 3 rounds: each round's loss and applied-update norm
  within rtol 1e-4, nonfinite 0, evaluate's accuracy equal; the float
  variables bit-equal across the ranks and each rank's variables and
  slots within 1e-4 x the largest magnitude + 1e-6 of the JAX device
  row; the int counter advanced by τ per round on every rank; the
  checkpoint tree in the JAX replica layout.
- `adapt_state` of a 4-row step into a world of one equal to the JAX
  trainer's (variables from row 0, float slots averaged in float64), and
  its refusals: a layer-backend step, tp = 2, a logical layout.
- A step written by each package's train loop resumes in the other's,
  one round on: the state equal, within the same tolerance, to the writer
  package resuming its own step.
- The graph apps against the JAX apps (`main()` in process, the JSONL
  records: losses within rtol 1e-4, test accuracies equal), and each CLI
  as a subprocess with `--device cpu`.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sparknet_tpu.apps import graph_common as jax_graph_common
from sparknet_tpu.apps import graph_imagenet_app as jax_graph_imagenet_app
from sparknet_tpu.apps import graph_mnist_app as jax_graph_mnist_app
from sparknet_tpu.backend import GraphDef as JaxGraphDef
from sparknet_tpu.backend import GraphNet as JaxGraphNet
from sparknet_tpu.backend import build_mnist_graph as jax_mnist_graph
from sparknet_tpu.backend.tf_import import import_tf_graphdef as jax_import
from sparknet_tpu.parallel import GraphTrainer as JaxGraphTrainer
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.utils.config import RunConfig as JaxRunConfig

import torch_graph_worker
from sparknet_tpu_torch.apps import graph_imagenet_app, graph_mnist_app
from sparknet_tpu_torch.apps.graph_common import train_graph
from sparknet_tpu_torch.backend import GraphBuilder, GraphNet
from sparknet_tpu_torch.data import imagenet, mnist
from sparknet_tpu_torch.data.dataset import ArrayDataset
from sparknet_tpu_torch.parallel.graph_trainer import GraphTrainer
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.utils.config import RunConfig
from test_torch_tf_import import _tf_graph_bytes

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 240
TAU, LB, ROUNDS = 2, 2, 3
TOL = dict(rtol=1e-4, atol=1e-6)


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want), initial=0.0))
    bound = TOL["rtol"] * float(np.max(np.abs(want), initial=0.0)) \
        + TOL["atol"]
    assert err <= bound, f"{what}: max abs err {err:.3e} > {bound:.3e}"


def _graph(kind):
    """(graph JSON, per-example data shape, label shape and dtype)."""
    if kind == "native":
        return (jax_mnist_graph(batch=LB, train_size=8).to_json(),
                (28, 28, 1), (1,), np.int32)
    return (jax_import(_tf_graph_bytes(), "tf").to_json(), (8, 8, 1), (),
            np.int64)


def _data(shape, lshape, ldt, world, seed=5):
    r = np.random.default_rng(seed)
    gb = world * LB
    rounds = [{"data": r.standard_normal((TAU, gb) + shape).astype(
        np.float32), "label": r.integers(0, 10, (TAU, gb) + lshape).astype(
            ldt)} for _ in range(ROUNDS)]
    ev = {"data": r.standard_normal((gb * 2,) + shape).astype(np.float32),
          "label": r.integers(0, 10, (gb * 2,) + lshape).astype(ldt)}
    return rounds, ev


def _spawn(fn, world, args):
    ctx = mp.spawn(fn, args=(world,) + args, nprocs=world, join=False)
    deadline = SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        deadline -= 5
        if deadline <= 0:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")


@pytest.mark.parametrize("kind", ["native", "imported"])
def test_two_gloo_ranks_match_a_jax_mesh_of_two(kind, tmp_path):
    text, shape, lshape, ldt = _graph(kind)
    rounds, ev = _data(shape, lshape, ldt, 2)
    jnet = JaxGraphNet(JaxGraphDef.from_json(text))
    init = {k: np.asarray(v) for k, v in jnet.variables.items()}
    trainer = JaxGraphTrainer(jnet, make_mesh(2), tau=TAU)
    state = trainer.init_state()
    want = {}
    for r, b in enumerate(rounds):
        want[f"acc/{r}"] = trainer.evaluate(state, ev)
        state, loss = trainer.train_round(state, b)
        want[f"loss/{r}"] = float(loss)
        want[f"grad_norm/{r}"] = float(trainer.last_health["grad_norm"])
        want[f"nonfinite/{r}"] = float(trainer.last_health["nonfinite"])
    _spawn(torch_graph_worker.run, 2,
           (str(tmp_path / "store"), text, init, rounds, ev, str(tmp_path)))
    res = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for r in range(ROUNDS):
        for got in res:
            assert float(got[f"acc/{r}"]) == pytest.approx(
                want[f"acc/{r}"], abs=1e-7)
            assert float(got[f"loss/{r}"]) == pytest.approx(
                want[f"loss/{r}"], rel=1e-4)
            assert float(got[f"grad_norm/{r}"]) == pytest.approx(
                want[f"grad_norm/{r}"], rel=1e-4)
            assert float(got[f"nonfinite/{r}"]) == want[f"nonfinite/{r}"] \
                == 0.0
            assert got[f"nonfinite_by_worker/{r}"].tolist() == [0.0, 0.0]
    jvars = {k: np.asarray(v) for k, v in state["variables"].items()}
    for k, v in jvars.items():
        if np.issubdtype(v.dtype, np.floating):
            # synced: bit-equal across the ranks after the average
            assert np.array_equal(res[0][f"variables/{k}"],
                                  res[1][f"variables/{k}"]), k
        else:  # the global step: local, advanced by τ a round
            assert int(res[0][f"variables/{k}"]) == \
                int(res[1][f"variables/{k}"]) == int(v[0]) == TAU * ROUNDS
        for rank in range(2):
            _close(res[rank][f"variables/{k}"], v[rank], f"{k} rank {rank}")
    jslots = {k: np.asarray(v) for k, v in state["slots"].items()}
    assert sorted(k[6:] for k in res[0].files if k.startswith("slots/")) \
        == sorted(jslots)
    if kind == "native":  # rank-local velocity: the ranks differ
        k = next(iter(jslots))
        assert not np.array_equal(res[0][f"slots/{k}"], res[1][f"slots/{k}"])
    for k, v in jslots.items():
        for rank in range(2):
            _close(res[rank][f"slots/{k}"], v[rank], f"slot {k} {rank}")
            _close(res[0][f"ckpt/slots/{k}"][rank], v[rank], f"ckpt {k}")
    assert res[0]["ckpt/it"].tolist() == [TAU * ROUNDS] * 2
    for k in jvars:
        assert res[0][f"ckpt/variables/{k}"].shape == jvars[k].shape


def _world_of_one(tmp_path, text):
    group = init_data_group("cpu", store_path=str(tmp_path / "s1"), rank=0,
                            world_size=1)
    net = GraphNet(_port_graph(text), device="cpu")
    return group, GraphTrainer(net, group, tau=TAU)


def _port_graph(text):
    from sparknet_tpu_torch.backend import GraphDef
    return GraphDef.from_json(text)


def test_adapt_state_across_world_sizes_and_its_refusals(tmp_path):
    text, *_ = _graph("native")
    jnet = JaxGraphNet(JaxGraphDef.from_json(text))
    r = np.random.default_rng(9)
    flat = {"it": np.full((4,), 6, np.int32)}
    for k, v in jnet.variables.items():
        row = r.standard_normal(np.shape(v)).astype(np.float32)
        flat[f"variables/{k}"] = np.stack([row] * 4)
        flat[f"slots/{k}"] = r.standard_normal(
            (4,) + np.shape(v)).astype(np.float32)
    want = JaxGraphTrainer(jnet, make_mesh(1), tau=TAU).adapt_state(flat)
    group, trainer = _world_of_one(tmp_path, text)
    try:
        for got in (trainer.adapt_state(flat),
                    trainer.state_from_checkpoint(flat, {"n_devices": 4})):
            assert got["it"] == int(np.asarray(want["it"])[0]) == 6
            for kind in ("variables", "slots"):
                assert sorted(got[kind]) == sorted(want[kind])
                for k, v in got[kind].items():
                    # row 0 exactly; the slot mean in float64, then float32
                    assert np.array_equal(v.numpy(),
                                          np.asarray(want[kind][k])[0]), k
        layer = {"params/conv1/w": np.zeros((1, 3, 3, 1, 4), np.float32),
                 "momentum/conv1/w": np.zeros((1, 3, 3, 1, 4), np.float32),
                 "it": np.zeros((1,), np.int32)}
        jt = JaxGraphTrainer(jnet, make_mesh(1), tau=TAU)
        for t in (jt, trainer):
            with pytest.raises(ValueError, match="cannot be adapted"):
                t.adapt_state(layer)
            with pytest.raises(ValueError, match="tensor parallelism"):
                t.adapt_state(flat, old_tp=2)
        with pytest.raises(ValueError, match="layer-IR trainer"):
            trainer.state_from_checkpoint(flat, {"layout": "logical"})
    finally:
        group.close()


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist")
    mnist.write_synthetic(str(d), n_train=64, n_test=16, seed=0)
    return d


def _mnist_ds(mnist_dir):
    loader = mnist.MnistLoader(str(mnist_dir))
    return (ArrayDataset(graph_mnist_app._nhwc(loader.train_batch_dict())),
            ArrayDataset(graph_mnist_app._nhwc(loader.test_batch_dict())))


def _run(pkg, cfg_kw, ckdir, workdir, train_ds, test_ds, text):
    kw = dict(tau=TAU, local_batch=8, eval_every=0, checkpoint_dir=ckdir,
              checkpoint_every=2, workdir=workdir, **cfg_kw)
    if pkg == "jax":
        cfg = JaxRunConfig(n_devices=1, **kw)
        state = jax_graph_common.train_graph(
            cfg, JaxGraphDef.from_json(text), train_ds, test_ds)
        return {"variables": {k: np.asarray(v)[0]
                              for k, v in state["variables"].items()},
                "slots": {k: np.asarray(v)[0]
                          for k, v in state["slots"].items()},
                "it": int(np.asarray(state["it"])[0])}
    state = train_graph(RunConfig(**kw), _port_graph(text), train_ds,
                        test_ds, device="cpu")
    return {"variables": {k: v.numpy() for k, v in state["variables"].items()},
            "slots": {k: v.numpy() for k, v in state["slots"].items()},
            "it": state["it"]}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")],
                         ids=["jax_step_in_port", "port_step_in_jax"])
def test_a_step_written_by_either_package_resumes_in_the_other(
        writer, reader, mnist_dir, tmp_path):
    text = jax_mnist_graph(batch=8, train_size=64).to_json()
    train_ds, test_ds = _mnist_ds(mnist_dir)
    ck = str(tmp_path / "ck")
    _run(writer, dict(max_rounds=2), ck, str(tmp_path / "w"), train_ds,
         test_ds, text)
    assert "step-2" in os.listdir(ck)
    other = str(tmp_path / "ck2")
    shutil.copytree(ck, other)
    want = _run(writer, dict(max_rounds=3, resume=True), ck,
                str(tmp_path / "w2"), train_ds, test_ds, text)
    got = _run(reader, dict(max_rounds=3, resume=True), other,
               str(tmp_path / "r"), train_ds, test_ds, text)
    assert got["it"] == want["it"] == 3 * TAU
    for kind in ("variables", "slots"):
        assert sorted(got[kind]) == sorted(want[kind])
        for k in want[kind]:
            _close(got[kind][k], want[kind][k], f"{kind}/{k}")


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


MNIST_OVERRIDES = ("max_rounds=3", "tau=2", "local_batch=8", "eval_every=2",
                   "eval_batch=16")
INET_OVERRIDES = ("crop=32", "local_batch=4", "tau=2", "max_rounds=3",
                  "eval_every=2", "eval_batch=8", "n_classes=4",
                  "precision=float32")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("imagenet")
    imagenet.write_synthetic_shards(str(d), n_shards=2, per_shard=12,
                                    n_classes=4, size=40, seed=0)
    imagenet.write_synthetic_shards(str(d), n_shards=1, per_shard=8,
                                    n_classes=4, size=40, seed=1,
                                    prefix="val")
    # a small graph at the crop: conv 3x3 SAME -> ReLU -> pool -> fc
    r = np.random.default_rng(2)
    g = GraphBuilder("inet32")
    g.placeholder("data", (4, 32, 32, 3))
    g.placeholder("label", (4,), dtype="int32")
    g.variable("c_w", 0.05 * r.standard_normal((3, 3, 3, 4)))
    g.variable("c_b", np.zeros(4))
    x = g.relu("relu", g.bias_add("cb", g.conv2d("c", "data", "c_w"),
                                  "c_b"))
    x = g.flatten("flat", g.max_pool("pool", x))
    g.variable("f_w", 0.01 * r.standard_normal((16 * 16 * 4, 4)))
    logits = g.matmul("logits", x, "f_w")
    g.accuracy("accuracy", logits, "label")
    g.finalize(loss=g.sparse_softmax_ce("loss", logits, "label"),
               learning_rate=0.001).save(str(d / "g.json"))
    return d


def test_the_graph_mnist_app_matches_the_jax_app(mnist_dir, tmp_path):
    jax_graph_mnist_app.main(["--data-dir", str(mnist_dir),
                              *MNIST_OVERRIDES, f"workdir={tmp_path / 'j'}",
                              "n_devices=1"])
    graph_mnist_app.main(["--device", "cpu", "--data-dir", str(mnist_dir),
                          *MNIST_OVERRIDES, f"workdir={tmp_path / 'p'}"])
    _held(_records(tmp_path / "p"), _records(tmp_path / "j"), 3)


def test_the_graph_imagenet_app_matches_the_jax_app(corpus, tmp_path):
    jax_graph_imagenet_app.main(["--graph", str(corpus / "g.json"),
                                 "--data-dir", str(corpus),
                                 *INET_OVERRIDES, f"workdir={tmp_path / 'j'}",
                                 "n_devices=1"])
    graph_imagenet_app.main(["--device", "cpu", "--graph",
                             str(corpus / "g.json"), "--data-dir",
                             str(corpus), *INET_OVERRIDES,
                             f"workdir={tmp_path / 'p'}"])
    _held(_records(tmp_path / "p"), _records(tmp_path / "j"), 3)


@pytest.mark.parametrize("app", ["graph_mnist_app", "graph_imagenet_app"])
def test_the_graph_clis_train_on_the_cpu(app, mnist_dir, corpus, tmp_path):
    args = (["--data-dir", str(mnist_dir), *MNIST_OVERRIDES]
            if app == "graph_mnist_app" else
            ["--graph", str(corpus / "g.json"), "--data-dir", str(corpus),
             *INET_OVERRIDES])
    env = dict(os.environ, SPARKNET_TPU_HOME=str(tmp_path))
    r = subprocess.run([sys.executable, "-m",
                        f"sparknet_tpu_torch.apps.{app}", "--device", "cpu",
                        *args, f"workdir={tmp_path}"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = _records(tmp_path)
    losses = [x["loss"] for x in recs if "loss" in x]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert any("test_accuracy" in x for x in recs)


def test_the_graph_loop_refuses_per_shard_steps_and_lr_backoff(mnist_dir,
                                                               tmp_path):
    """Checkpoints are monolithic on the graph backend ("on" raises, as in
    the JAX loop; "auto" saves state.npz), and its trainer takes no
    lr_scale or per-worker τ."""
    text = jax_mnist_graph(batch=8, train_size=64).to_json()
    train_ds, test_ds = _mnist_ds(mnist_dir)
    kw = dict(tau=TAU, local_batch=8, max_rounds=2, checkpoint_every=2,
              eval_every=0)
    with pytest.raises(ValueError, match="layer-IR trainer"):
        train_graph(RunConfig(checkpoint_dir=str(tmp_path / "on"),
                              checkpoint_sharded="on",
                              workdir=str(tmp_path / "w1"), **kw),
                    _port_graph(text), train_ds, device="cpu")
    train_graph(RunConfig(checkpoint_dir=str(tmp_path / "auto"),
                          workdir=str(tmp_path / "w2"), **kw),
                _port_graph(text), train_ds, device="cpu")
    assert os.path.exists(tmp_path / "auto" / "step-2" / "state.npz")
    group, trainer = _world_of_one(tmp_path, text)
    try:
        state = trainer.init_state()
        b = {k: np.stack([v[:8]] * TAU) for k, v in train_ds.arrays.items()}
        with pytest.raises(ValueError, match="lr_scale"):
            trainer.train_round(state, b, lr_scale=0.5)
        with pytest.raises(ValueError, match="per-worker"):
            trainer.train_round(state, b, tau_by_worker=[1])
        assert trainer.supports_lr_scale is False
    finally:
        group.close()
