"""The port's model files — prototxt nets and solvers, binary `.caffemodel`
weights, `TorchNet.save_weights` / `load_weights`, `--weights` in the serve
CLI and `.prototxt` models in the train loop — against the JAX package's.

Fixtures are inline: the prototxt strings of `tests/test_prototxt.py`, a
small LRN/pooling/dropout net written here, and files the two packages
write themselves. Specs and solver configs must be equal field for field
(`dataclasses.asdict`), refusals must raise in both with the same
message, `.caffemodel` files must have the same bytes and read back
equal, and a forward of weights that crossed packages must agree within
atol 1e-5 (the two packages' convolutions sum in another order).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import test_caffemodel as jax_caffemodel_tests
import test_prototxt as jax_prototxt_tests
from sparknet_tpu.model import caffemodel as jax_caffemodel
from sparknet_tpu.model import prototxt as jax_prototxt
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.solver import SolverConfig as JaxSolverConfig

from sparknet_tpu_torch.apps.train_loop import resolve_spec, train
from sparknet_tpu_torch.data.dataset import ArrayDataset
from sparknet_tpu_torch.model import caffemodel, prototxt
from sparknet_tpu_torch.model.caffe_compat import collection_to_params
from sparknet_tpu_torch.model.net import CompiledNet
from sparknet_tpu_torch.model.weights import WeightCollection
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.serve import app as serve_app
from sparknet_tpu_torch.solver import SolverConfig
from sparknet_tpu_torch.utils.config import RunConfig
from sparknet_tpu_torch.utils.logger import Logger

torch.set_num_threads(2)

# a small net of the layer types CaffeNet trains with (conv, ReLU, LRN,
# MAX and AVE pooling, inner product, dropout, accuracy, loss)
SMALL = """
name: "small"
input: "data"
input_shape { dim: 4 dim: 3 dim: 12 dim: 12 }
input: "label"
input_shape { dim: 4 dim: 1 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  param { lr_mult: 1 } param { lr_mult: 2 }
  convolution_param { num_output: 8 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "pool2" type: "Pooling" bottom: "pool1" top: "pool2"
  pooling_param { pool: AVE kernel_size: 2 stride: 1 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool2" top: "ip1"
  inner_product_param { num_output: 16
    weight_filler { type: "xavier" } } }
layer { name: "drop1" type: "Dropout" bottom: "ip1" top: "ip1"
  dropout_param { dropout_ratio: 0.5 } }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
  inner_product_param { num_output: 5
    weight_filler { type: "gaussian" std: 0.01 } } }
layer { name: "accuracy" type: "Accuracy" bottom: "ip2" bottom: "label"
  top: "accuracy" include { phase: TEST } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label"
  top: "loss" }
"""
_BASE = """
name: "g"
input: "data"
input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
layer {
  name: "c" type: "Convolution" bottom: "data" top: "c"
  convolution_param { num_output: 4 %s }
}
"""
NETS = {"adult": jax_prototxt_tests.ADULT, "small": SMALL,
        "square": _BASE % "kernel_size: 3 pad: 1",
        "square_h_w": _BASE % "kernel_h: 3 kernel_w: 3 pad_h: 1 pad_w: 1"}
REFUSED = {
    "kernel_h_w": _BASE % "kernel_h: 3 kernel_w: 5",
    "stride_h": _BASE % "stride_h: 2",
    "pad_w": _BASE % "pad_w: 1",
    "dilation": _BASE % "dilation: 2",
    "conflicting": _BASE % "kernel_size: 5 kernel_h: 3 kernel_w: 3",
    "pool_h": """
    name: "g"
    input: "data"
    input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
    layer {
      name: "p" type: "Pooling" bottom: "data" top: "p"
      pooling_param { pool: MAX kernel_h: 2 }
    }
    """,
    "concat_axis": """
    name: "g"
    input: "a"
    input_shape { dim: 1 dim: 4 }
    input: "b"
    input_shape { dim: 1 dim: 4 }
    layer {
      name: "cat" type: "Concat" bottom: "a" bottom: "b" top: "cat"
      concat_param { axis: 2 }
    }
    """,
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_prototxt_builds_an_equal_spec(name):
    assert dataclasses.asdict(prototxt.net_from_prototxt(NETS[name])) == \
        dataclasses.asdict(jax_prototxt.net_from_prototxt(NETS[name]))


def test_prototxt_file_with_input_shapes(tmp_path):
    path = tmp_path / "small.prototxt"
    path.write_text(SMALL)
    shapes = {"data": (2, 3, 12, 12), "label": (2, 1)}
    got = prototxt.net_from_prototxt_file(str(path), input_shapes=shapes)
    want = jax_prototxt.net_from_prototxt_file(str(path),
                                               input_shapes=shapes)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.inputs[0].shape == (2, 3, 12, 12)


def test_parse_message_and_solver_equal():
    text = 'a: 1 b { c: "x" c: "y" } a: 2'
    assert prototxt.parse_message(text) == jax_prototxt.parse_message(text)
    got = prototxt.solver_from_prototxt(jax_prototxt_tests.SOLVER)
    assert got == jax_prototxt.solver_from_prototxt(
        jax_prototxt_tests.SOLVER)
    assert dataclasses.asdict(SolverConfig.from_dict(got)) == \
        dataclasses.asdict(JaxSolverConfig.from_dict(got))


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unimplemented_geometry_is_refused_in_both(name):
    with pytest.raises(ValueError) as theirs:
        jax_prototxt.net_from_prototxt(REFUSED[name])
    with pytest.raises(ValueError) as mine:
        prototxt.net_from_prototxt(REFUSED[name])
    assert str(mine.value) == str(theirs.value)


# -- .caffemodel ------------------------------------------------------------


def _net_pair(seed=3, spec_text=SMALL):
    """A JaxNet and a TorchNet holding the same weights."""
    jnet = JaxNet(jax_prototxt.net_from_prototxt(spec_text), seed=seed)
    tnet = TorchNet(prototxt.net_from_prototxt(spec_text), device="cpu")
    tnet.load_jax_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, tnet


def test_caffemodel_files_have_the_same_bytes(tmp_path):
    jnet, tnet = _net_pair()
    jnet.save_weights(str(tmp_path / "j.caffemodel"))
    tnet.save_weights(str(tmp_path / "t.caffemodel"))
    assert (tmp_path / "t.caffemodel").read_bytes() == \
        (tmp_path / "j.caffemodel").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_caffemodel_reads_back_equal_in_the_other_package(tmp_path,
                                                            writer):
    jnet, tnet = _net_pair()
    path = str(tmp_path / "w.caffemodel")
    (jnet if writer == "jax" else tnet).save_weights(path)
    mine = caffemodel.load_caffemodel_file(path)
    theirs = jax_caffemodel.load_caffemodel_file(path)
    assert mine.layer_names == theirs.layer_names == \
        ["conv1", "ip1", "ip2"]
    for name in mine.layer_names:
        for a, b in zip(mine[name], theirs[name]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(mine[name], tnet.get_weights()[name]):
            np.testing.assert_array_equal(a, b)


def test_legacy_v1_layers_parse_as_the_reference_parses_them():
    blob = jax_caffemodel_tests._legacy_blob
    tag, varint, delim = (jax_caffemodel._tag, jax_caffemodel._varint,
                          jax_caffemodel._len_delim)
    w = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
    b = np.array([0.5, -0.5], np.float32)
    head = np.arange(12, dtype=np.float32).reshape(1, 3, 2, 2)
    layers = (delim(2, delim(4, b"conv1") + tag(5, 0) + varint(4)
                    + delim(6, blob(w, (2, 3, 2, 2)))
                    + delim(6, blob(b, (1, 1, 1, 2))))
              + delim(2, delim(4, b"head") + tag(5, 0) + varint(4)
                      + delim(6, blob(head, (1, 3, 2, 2)))))
    raw = delim(1, b"legacy") + layers
    mine, theirs = (caffemodel.load_caffemodel(raw),
                    jax_caffemodel.load_caffemodel(raw))
    assert mine.layer_names == theirs.layer_names == ["conv1", "head"]
    for name in mine.layer_names:
        assert [a.shape for a in mine[name]] == \
            [a.shape for a in theirs[name]]
        for a, c in zip(mine[name], theirs[name]):
            np.testing.assert_array_equal(a, c)
    assert mine["conv1"][1].shape == (2,)        # (1,1,1,2) -> (2,)
    assert mine["head"][0].shape == (1, 3, 2, 2)  # num=1 keeps its 4-D


def test_legacy_inner_product_blobs_load_into_the_port():
    """A legacy (1, 1, out, in) inner-product weight and a (1, 1, 1, out)
    bias canonicalise into the net's (out, in) / (out,) params."""
    spec = prototxt.net_from_prototxt(jax_prototxt_tests.ADULT)
    net = CompiledNet.compile(spec)
    like = net.init_params(torch.Generator().manual_seed(0),
                           torch.device("cpu"))
    w = np.arange(10, dtype=np.float32).reshape(1, 1, 10, 1)
    got = collection_to_params(net, WeightCollection(
        {"ip": [w, np.ones((1, 1, 1, 10), np.float32)]}, ["ip"]), like)
    np.testing.assert_array_equal(got["ip"]["w"].numpy(), w.reshape(10, 1))
    assert got["ip"]["b"].shape == (10,)


def _batch(seed=0):
    r = np.random.default_rng(seed)
    return {"data": r.standard_normal((4, 3, 12, 12)).astype(np.float32),
            "label": r.integers(0, 5, (4, 1)).astype(np.int32)}


@pytest.mark.parametrize("suffix", [".caffemodel", ".npz"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_saved_weights_forward_the_same_in_the_other_package(tmp_path,
                                                             suffix,
                                                             direction):
    src_j, src_t = _net_pair(seed=5)
    dst_j = JaxNet(jax_prototxt.net_from_prototxt(SMALL), seed=0)
    dst_t = TorchNet(prototxt.net_from_prototxt(SMALL), seed=0,
                     device="cpu")
    path = str(tmp_path / f"w{suffix}")
    if direction == "port_to_jax":
        src_t.save_weights(path)
        dst_j.load_weights(path)
        got, want = dst_j, src_t
    else:
        src_j.save_weights(path)
        dst_t.load_weights(path)
        got, want = dst_t, src_j
    g = got.forward(_batch(), ["ip2"])
    w = want.forward(_batch(), ["ip2"])
    assert sorted(g) == sorted(w) == ["accuracy", "ip2", "loss"]
    for k in g:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                   atol=1e-5, rtol=0)


def test_torchnet_weights_round_trip_bit_for_bit(tmp_path):
    _, src = _net_pair(seed=9)
    for suffix in (".caffemodel", ".npz"):
        dst = TorchNet(prototxt.net_from_prototxt(SMALL), device="cpu")
        src.save_weights(str(tmp_path / f"w{suffix}"))
        dst.load_weights(str(tmp_path / f"w{suffix}"))
        for l, lp in src.params.items():
            for p, t in lp.items():
                assert torch.equal(dst.params[l][p], t), (suffix, l, p)


# -- the entry points -------------------------------------------------------


def test_serve_cli_takes_a_prototxt_model_and_weights(tmp_path, capsys,
                                                     monkeypatch):
    path = tmp_path / "adult.prototxt"
    path.write_text(jax_prototxt_tests.ADULT)
    jnet = JaxNet(jax_prototxt.net_from_prototxt(jax_prototxt_tests.ADULT),
                  seed=4)
    jnet.save_weights(str(tmp_path / "adult.caffemodel"))
    served = []

    class Recording(serve_app.InferenceServer):
        def __init__(self, net, *a, **k):
            served.append(net)
            super().__init__(net, *a, **k)

    monkeypatch.setattr(serve_app, "InferenceServer", Recording)
    serve_app.main(["--model", str(path), "--weights",
                    str(tmp_path / "adult.caffemodel"), "--device", "cpu",
                    "--max-batch", "8", "--demo", "3",
                    "--workdir", str(tmp_path)])
    status = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the serving name is --model-name ("default"), as in the JAX CLI
    assert status["requests_ok"] == 3 and status["model"] == "default"
    (net,) = served
    assert dataclasses.asdict(net.net.spec) == dataclasses.asdict(
        jax_prototxt.net_from_prototxt(jax_prototxt_tests.ADULT))
    assert WeightCollection.check_equal(net.get_weights(),
                                        jnet.get_weights(), tol=0.0)


def test_a_prototxt_model_and_solver_train_one_round(tmp_path):
    net_path, solver_path = tmp_path / "small.prototxt", tmp_path / "s.pt"
    net_path.write_text(SMALL)
    solver_path.write_text("base_lr: 0.02\nmomentum: 0.8\n"
                           "lr_policy: \"fixed\"\nweight_decay: 0.001\n")
    cfg = RunConfig(model=str(net_path), solver_prototxt=str(solver_path),
                    tau=2, local_batch=2, max_rounds=1, eval_every=0,
                    workdir=str(tmp_path))
    spec = resolve_spec(cfg, data=(2, 3, 12, 12), label=(2, 1))
    assert spec.inputs[0].shape == (2, 3, 12, 12)
    r = np.random.default_rng(1)
    ds = ArrayDataset({
        "data": r.standard_normal((8, 3, 12, 12)).astype(np.float32),
        "label": r.integers(0, 5, (8, 1)).astype(np.int32)})
    rounds = []

    class Capture(Logger):
        def metrics(self, step, **kv):
            rounds.append(kv)

    state = train(cfg, spec, ds, device="cpu",
                  logger=Capture(echo=False))
    assert (cfg.solver.base_lr, cfg.solver.momentum) == (0.02, 0.8)
    assert state.it == 2 and len(rounds) == 1
    assert np.isfinite(rounds[0]["loss"])
