"""The port's second backend (`sparknet_tpu_torch/backend/`) against the
JAX package's, on the CPU.

The same graphs (built by each package's `builder.py`, byte-equal in JSON)
and the same seeded numpy batches go through `sparknet_tpu.backend.
GraphNet` and the port's `GraphNet`, with the same variables (the builder
bakes them into the graph; random initial values cannot match and are
carried across with `set_weights`).
- The JSON round trip: byte-equal to the JAX package's `to_json`, both
  ways; the builders' graphs node for node, attr for attr (the mnist and
  the full-width AlexNet graph).
- Introspection (inputs, variables, outputs, shapes, dtypes, the serve
  door's `net_input_specs`) equal; the protocol checks (an incomplete
  update/assign pair, a schema mismatch, an unknown op, a graph without an
  optimizer) raise as the JAX package raises.
- Forward of the mnist graph and of a 64x64 AlexNet-shaped graph (11x11
  stride-4 SAME conv1, VALID 3/2 pools, three fc): every evaluable node
  within 1e-5 x its largest magnitude + 1e-6, per tensor (float32; matrix
  and convolution sums run in another order); NCHW batches accepted.
- `step` with the `exp_decay` schedule across two decay boundaries: each
  step's lr equal to the JAX lr within 1e-6 relative, losses and
  variables after 5 steps within 1e-4 x their largest magnitude + 1e-6;
  `set_weights` leaves the slots untouched and the next step still
  agrees.
- Gradients against `jax.grad` on a tie-heavy input (ReLU pre-activations
  exactly 0, equal values inside max-pool windows), with asymmetric SAME
  padding at strides 2 and 4, for int64 (B,) and int32 (B, 1) labels:
  within 1e-5 x the largest magnitude + 1e-6 (a tie routed or split
  otherwise than JAX moves whole gradient entries, far past that).
- dtypes as JAX holds them with 64-bit types off (float64 initializers and
  constants float32, int64 int32, ArgMax int32), and a 10k-node chain.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.backend import GraphBuilder as JaxBuilder
from sparknet_tpu.backend import GraphDef as JaxGraphDef
from sparknet_tpu.backend import GraphNet as JaxGraphNet
from sparknet_tpu.backend import build_alexnet_graph as jax_alexnet
from sparknet_tpu.backend import build_mnist_graph as jax_mnist
from sparknet_tpu.schema import Field as JaxField
from sparknet_tpu.schema import Schema as JaxSchema
from sparknet_tpu.serve.server import net_input_specs as jax_specs

from sparknet_tpu_torch.backend import (GraphBuilder, GraphDef, GraphNet,
                                        NodeDef, build_alexnet_graph,
                                        build_mnist_graph)
from sparknet_tpu_torch.backend.graphdef import UPDATE_SUFFIX
from sparknet_tpu_torch.model.weights import WeightCollection
from sparknet_tpu_torch.schema import Field, Schema
from sparknet_tpu_torch.serve.server import net_input_specs

torch.set_num_threads(2)

FWD = dict(rtol=1e-5, atol=1e-6)
STEP = dict(rtol=1e-4, atol=1e-6)


def alexnet64(batch=4, n_classes=10, seed=0, builder=GraphBuilder):
    """`build_alexnet_graph`'s structure at 64x64 and narrow widths: conv1
    11x11 stride 4 SAME (64 -> 16), VALID 3/2 pools (16 -> 7 -> 3 -> 1),
    5x5 and three 3x3 SAME convs, fc -> fc -> logits, Momentum 0.9."""
    r = np.random.default_rng(seed)
    g = builder("alexnet64")
    g.placeholder("data", (batch, 64, 64, 3))
    g.placeholder("label", (batch,), dtype="int32")
    chans = [(11, 3, 8, 4), (5, 8, 12, 1), (3, 12, 16, 1), (3, 16, 16, 1),
             (3, 16, 8, 1)]
    x = "data"
    for i, (k, cin, cout, stride) in enumerate(chans, start=1):
        g.variable(f"conv{i}_w", 0.1 * r.standard_normal((k, k, cin, cout)))
        g.variable(f"conv{i}_b", 0.05 * r.standard_normal(cout))
        x = g.conv2d(f"conv{i}", x, f"conv{i}_w", stride=stride)
        x = g.relu(f"relu{i}", g.bias_add(f"conv{i}_biased", x,
                                          f"conv{i}_b"))
        if i in (1, 2, 5):
            x = g.max_pool(f"pool{i}", x, ksize=3, strides=2,
                           padding="VALID")
    f = g.flatten("flat", x)
    dims = [(8, 32), (32, 32), (32, n_classes)]
    h = f
    for j, (din, dout) in enumerate(dims, start=6):
        g.variable(f"fc{j}_w", 0.1 * r.standard_normal((din, dout)))
        g.variable(f"fc{j}_b", 0.1 * np.ones(dout))
        h = g.add(f"fc{j}_biased", g.matmul(f"fc{j}", h, f"fc{j}_w"),
                  f"fc{j}_b")
        if j < 8:
            h = g.relu(f"relu{j}", h)
    g.softmax("prob", h)
    g.accuracy("accuracy", h, "label")
    loss = g.sparse_softmax_ce("loss", h, "label")
    return g.finalize(loss=loss, learning_rate=0.01, momentum=0.9)


def _pair(graph_json: str, **kw):
    """Both packages' nets of one graph JSON."""
    return (JaxGraphNet(JaxGraphDef.from_json(graph_json), **kw),
            GraphNet(GraphDef.from_json(graph_json), device="cpu", **kw))


def _mnist_batch(n=4, seed=0, label_col=True):
    r = np.random.default_rng(seed)
    lab = r.integers(0, 10, (n, 1) if label_col else (n,))
    return {"data": r.standard_normal((n, 28, 28, 1)).astype(np.float32),
            "label": lab.astype(np.int32 if label_col else np.int64)}


def _close(got, want, what, tol):
    """Per tensor: max |port - JAX| <= rtol * max |JAX| + atol (a sum run
    in another order errs by ulps of its largest terms, not of its
    result)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    bound = tol["rtol"] * float(np.max(np.abs(want), initial=0.0)) \
        + tol["atol"]
    assert err <= bound, f"{what}: max abs err {err:.3e} > {bound:.3e}"


def _hidden(net):
    """Every evaluable non-protocol node of a JAX net."""
    return [n.name for n in net.graph.nodes
            if n.op not in ("Placeholder", "Variable", "Assign", "NoOp",
                            "Train", "Const")
            and net._evaluable(n.name)]


@pytest.fixture(scope="module")
def mnist_json():
    return jax_mnist(batch=4).to_json()


@pytest.mark.parametrize("which", ["mnist", "alexnet", "alexnet64"])
def test_the_json_round_trip_is_byte_equal_to_the_jax_package(which):
    if which != "alexnet64":
        # the builders (alexnet at full width, 227/1000): node for node,
        # attr for attr (JSON of their millions of floats is slow here)
        port, jax_ = ((build_mnist_graph(batch=4), jax_mnist(batch=4))
                      if which == "mnist" else
                      (build_alexnet_graph(batch=2), jax_alexnet(batch=2)))
        for a, b in zip(port.nodes, jax_.nodes):
            assert (a.name, a.op, a.inputs) == (b.name, b.op, b.inputs)
            assert a.attrs.keys() == b.attrs.keys()
            for k, v in a.attrs.items():
                w = b.attrs[k]
                if isinstance(v, np.ndarray):
                    assert v.dtype == w.dtype and np.array_equal(v, w), \
                        (a.name, k)
                else:
                    assert v == w, (a.name, k)
        assert len(port.nodes) == len(jax_.nodes)
        return
    port, jax_ = alexnet64(), alexnet64(builder=JaxBuilder)
    text = jax_.to_json()
    assert port.to_json() == text
    assert GraphDef.from_json(text).to_json() == text
    assert JaxGraphDef.from_json(port.to_json()).to_json() == text


def test_introspection_and_protocol_checks(mnist_json):
    graph = JaxGraphDef.from_json(mnist_json)
    jnet, pnet = _pair(mnist_json)
    for attr in ("input_names", "variable_names"):
        assert getattr(pnet, attr) == getattr(jnet, attr)
    assert pnet.output_names() == jnet.output_names()
    assert pnet.input_shapes() == jnet.input_shapes()
    assert pnet.input_dtypes() == jnet.input_dtypes()
    assert net_input_specs(pnet) == jax_specs(jnet)
    assert pnet.forward_shapes(_hidden(jnet)) == jnet.forward_shapes(
        _hidden(jnet))
    assert [(f.name, f.dtype, f.shape) for f in pnet.output_schema().fields] \
        == [(f.name, f.dtype, f.shape) for f in jnet.output_schema().fields]
    for v in jnet.variable_names:
        assert np.array_equal(pnet.variables[v].numpy(),
                              np.asarray(jnet.variables[v])), v
    # an incomplete update/assign pair
    nodes = [n for n in build_mnist_graph(batch=4).nodes
             if n.name != "conv1_w" + UPDATE_SUFFIX]
    with pytest.raises(ValueError, match="incomplete"):
        GraphNet(GraphDef(name="m", nodes=nodes), device="cpu")
    # schema columns against graph inputs
    with pytest.raises(ValueError, match="schema columns"):
        JaxGraphNet(graph, schema=JaxSchema(JaxField("data", "float32",
                                                     (28, 28, 1))))
    with pytest.raises(ValueError, match="schema columns"):
        GraphNet(build_mnist_graph(batch=4), device="cpu",
                 schema=Schema(Field("data", "float32", (28, 28, 1))))
    # an unknown op fails at its forward, naming the op
    bad = GraphDef(name="bad", nodes=[
        NodeDef("x", "Placeholder", attrs={"shape": [1], "dtype": "float32"}),
        NodeDef("y", "FancyOp", inputs=["x"])])
    with pytest.raises(ValueError, match="FancyOp"):
        GraphNet(bad, device="cpu").forward({"x": np.zeros(1, np.float32)},
                                            ["y"])
    # no optimizer and no loss: step refuses, as in the JAX package
    g = GraphBuilder("noopt")
    g.placeholder("x", (2, 3))
    g.variable("w", np.ones((3, 2), np.float32))
    g.matmul("y", "x", "w")
    with pytest.raises(ValueError, match="loss"):
        GraphNet(g.finalize(), device="cpu").step(
            {"x": np.zeros((2, 3), np.float32)})


@pytest.mark.parametrize("which", ["mnist", "alexnet64"])
def test_forward_matches_the_jax_graph_net(which, mnist_json):
    if which == "mnist":
        text, batch = mnist_json, _mnist_batch()
    else:
        r = np.random.default_rng(1)
        text = alexnet64(builder=JaxBuilder).to_json()
        batch = {"data": r.standard_normal((4, 64, 64, 3)).astype(
            np.float32), "label": r.integers(0, 10, (4,)).astype(np.int32)}
    jnet, pnet = _pair(text)
    names = _hidden(jnet)
    want = jnet.forward(batch, names)
    got = pnet.forward(batch, names)
    for k in names:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        _close(got[k], want[k], k, FWD)
    # the default fetches are the graph's outputs
    assert sorted(pnet.forward(batch)) == sorted(jnet.forward(batch))


def test_forward_accepts_nchw(mnist_json):
    jnet, pnet = _pair(mnist_json)
    batch = _mnist_batch()
    nchw = dict(batch, data=np.ascontiguousarray(
        np.transpose(batch["data"], (0, 3, 1, 2))))
    want = jnet.forward(nchw, ["prob"])["prob"]
    got = pnet.forward(nchw, ["prob"])["prob"]
    assert np.array_equal(got, pnet.forward(batch, ["prob"])["prob"])
    _close(got, want, "prob", FWD)


def test_step_follows_the_exp_decay_schedule_and_set_weights_keeps_slots():
    """decay_steps = 8 / 4 = 2: the lr drops at steps 2 and 4."""
    text = jax_mnist(batch=4, train_size=8).to_json()
    jnet, pnet = _pair(text)
    jopt, popt = jnet.discover_optimizer(), pnet.discover_optimizer()
    assert popt.trainable == jopt.trainable
    assert popt.momentum == jopt.momentum
    for it in range(6):
        _close(popt.lr_fn(pnet.variables, it),
               jopt.lr_fn(jnet.variables, jnp.asarray(it, jnp.int32)),
               f"lr at it {it}", dict(rtol=1e-6, atol=0))
    for s in range(5):
        b = _mnist_batch(seed=10 + s)
        _close(pnet.step(b), jnet.step(b), f"loss {s}", STEP)
    for v in jnet.variable_names:
        _close(pnet.variables[v], jnet.variables[v], v, STEP)
    assert pnet._it == int(jnet._it) == 5
    # set_weights assigns the named variables and never touches a slot
    slots = {k: v.clone() for k, v in pnet._slots.items()}
    r = np.random.default_rng(7)
    names = ["fc2_w", "fc2_b"]
    wc = WeightCollection({v: [0.1 * r.standard_normal(
        tuple(pnet.variables[v].shape))] for v in names}, names)
    pnet.set_weights(wc)
    jnet.set_weights(wc)
    for k, v in slots.items():
        assert torch.equal(pnet._slots[k], v), k
    for v in names:
        assert np.array_equal(pnet.variables[v].numpy(), wc[v][0])
    assert pnet.get_weights().layer_names == jnet.get_weights().layer_names
    b = _mnist_batch(seed=20)
    _close(pnet.step(b), jnet.step(b), "loss after set_weights", STEP)
    for v in jnet.variable_names:
        _close(pnet.variables[v], jnet.variables[v], v, STEP)


def _tie_graph(size, k, stride, label_shape, label_dtype):
    """conv (SAME, k x k, `stride`) -> ReLU -> 2x2/2 SAME max pool ->
    flatten -> fc -> cross-entropy and accuracy; weights on a grid of
    0.25, so sums are exact and ties are real."""
    r = np.random.default_rng(size + stride)
    g = GraphBuilder("ties")
    g.placeholder("data", (4, size, size, 2))
    g.placeholder("label", (4,) + label_shape, dtype=label_dtype)
    g.variable("c_w", 0.25 * r.integers(-2, 3, (k, k, 2, 3)))
    g.variable("c_b", np.zeros(3))
    x = g.relu("relu", g.bias_add("cb", g.conv2d("c", "data", "c_w",
                                                 stride=stride), "c_b"))
    x = g.flatten("flat", g.max_pool("pool", x, ksize=2, strides=2))
    out = -(-size // stride)
    pooled = -(-out // 2)
    g.variable("f_w", 0.25 * r.integers(-2, 3, (pooled * pooled * 3, 5)))
    logits = g.matmul("logits", x, "f_w")
    g.accuracy("accuracy", logits, "label")
    loss = g.sparse_softmax_ce("loss", logits, "label")
    return g.finalize(loss=loss)


@pytest.mark.parametrize("stride,k,labels", [
    (2, 3, "int64"), (4, 5, "int64"), (2, 3, "column"), (4, 5, "column")])
def test_gradients_match_jax_grad_on_ties_and_asymmetric_same(stride, k,
                                                              labels):
    size = 10  # SAME: stride 2, k 3 pads (0, 1); stride 4, k 5 pads (1, 2)
    shape, dt = (((1,), "int32") if labels == "column" else ((), "int64"))
    graph = _tie_graph(size, k, stride, shape, dt)
    jnet, pnet = _pair(graph.to_json())
    r = np.random.default_rng(3)
    # a few integer levels with zero blocks: exact zeros before the ReLU,
    # equal maxima inside pool windows
    data = r.integers(0, 3, (4, size, size, 2)).astype(np.float32)
    data[:, :4, :4] = 0
    data[:, 6:, 6:] = 1
    lab = r.integers(0, 5, (4,) + shape).astype(dt)
    batch = {"data": data, "label": lab}
    want_ties = np.asarray(jnet.forward(batch, ["relu"])["relu"])
    assert (want_ties == 0).mean() > 0.2  # ReLU ties at 0 are present

    trainable = jnet.discover_optimizer().trainable
    jb = jnet._prep(batch)

    def jloss(tv):
        return jnet._eval(dict(jnet.variables, **tv), jb, ("loss",))[0]

    jl, jg = jax.value_and_grad(jloss)({v: jnet.variables[v]
                                        for v in trainable})
    pb = pnet._prep(batch)
    tv = {v: pnet.variables[v].clone().requires_grad_(True)
          for v in trainable}
    pl = pnet._eval(dict(pnet.variables, **tv), pb, ("loss",))[0]
    pg = torch.autograd.grad(pl, [tv[v] for v in trainable])
    _close(pl.detach(), jl, "loss", FWD)
    for v, g in zip(trainable, pg):
        _close(g, jg[v], f"d loss / d {v}", FWD)
    # the accuracy with either label layout
    _close(pnet.forward(batch, ["accuracy"])["accuracy"],
           jnet.forward(batch, ["accuracy"])["accuracy"], "accuracy", FWD)


def test_same_padding_is_tf_s_asymmetric_padding():
    """conv and pool outputs of a non-square input at strides 2 and 4
    (ceil(size / stride), padding low total // 2 and high the rest)."""
    from sparknet_tpu.backend.graphdef import OPS as JAX_OPS
    from sparknet_tpu_torch.backend.graphdef import OPS
    r = np.random.default_rng(8)
    x = r.standard_normal((2, 9, 6, 3)).astype(np.float32)
    w = r.standard_normal((5, 3, 3, 4)).astype(np.float32)
    for s in (2, 4):
        n = NodeDef("c", "Conv2D", ["x", "w"], {"strides": [s, s],
                                                 "padding": "SAME"})
        got = OPS["Conv2D"](n, [torch.from_numpy(x), torch.from_numpy(w)])
        want = JAX_OPS["Conv2D"](n, [jnp.asarray(x), jnp.asarray(w)])
        assert tuple(got.shape) == tuple(want.shape) == (
            2, -(-9 // s), -(-6 // s), 4)
        _close(got, want, f"conv stride {s}", FWD)
        n = NodeDef("p", "MaxPool", ["x"], {"ksize": 3, "strides": s,
                                            "padding": "SAME"})
        got = OPS["MaxPool"](n, [torch.from_numpy(x)])
        want = JAX_OPS["MaxPool"](n, [jnp.asarray(x)])
        assert tuple(got.shape) == tuple(want.shape)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_dtypes_follow_jax_with_64_bit_types_off():
    nodes = [
        NodeDef("x", "Placeholder", attrs={"shape": [2, 3],
                                           "dtype": "float32"}),
        NodeDef("ids", "Placeholder", attrs={"shape": [2],
                                             "dtype": "int64"}),
        NodeDef("w", "Variable", attrs={"init": np.ones((3, 2), np.float64),
                                        "shape": [3, 2]}),
        NodeDef("step", "Variable", attrs={"shape": [], "dtype": "int64"}),
        NodeDef("k", "Const", attrs={"value": np.float64(0.5)}),
        NodeDef("y", "MatMul", ["x", "w"]),
        NodeDef("z", "Mul", ["y", "k"]),
        NodeDef("am", "ArgMax", ["z"], {"axis": 1}),
        NodeDef("c", "Cast", ["z"], {"dtype": "int64"}),
        NodeDef("s", "Add", ["ids", "step"]),
        NodeDef("m", "Mean", ["ids"], {"axis": None}),
    ]
    text = GraphDef(name="dt", nodes=nodes).to_json()
    jnet, pnet = _pair(text)
    batch = {"x": np.arange(6, dtype=np.float32).reshape(2, 3),
             "ids": np.array([3, 4], np.int64)}
    names = ["y", "z", "am", "c", "s", "m"]
    want = jnet.forward(batch, names)
    got = pnet.forward(batch, names)
    for k in names:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], np.asarray(want[k])), k
    for v in ("w", "step"):
        assert pnet.variables[v].numpy().dtype == \
            np.asarray(jnet.variables[v]).dtype, v
    assert pnet.get_weights().layer_names == ["w"]  # int counter skipped


def test_random_initial_values_come_from_a_seeded_generator():
    """A Variable with only a shape: the port draws it from a seeded
    torch.Generator on the CPU (it cannot equal jax.random's bits): the
    same seed gives the same values, another seed others, with the std."""
    nodes = [NodeDef("w", "Variable", attrs={"shape": [64, 64],
                                             "stddev": 0.5})]
    g = GraphDef(name="rnd", nodes=nodes)
    a = GraphNet(g, seed=1, device="cpu").variables["w"]
    b = GraphNet(g, seed=1, device="cpu").variables["w"]
    c = GraphNet(g, seed=2, device="cpu").variables["w"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32
    assert abs(float(a.std()) - 0.5) < 0.05
    assert tuple(np.asarray(JaxGraphNet(g, seed=1).variables["w"]).shape) \
        == tuple(a.shape)


def test_deep_chain_graph_no_recursion_limit():
    depth = 10_000
    assert depth > sys.getrecursionlimit()
    nodes = [NodeDef(name="data", op="Placeholder",
                     attrs={"shape": (2, 4), "dtype": "float32"}),
             NodeDef(name="c", op="Const",
                     attrs={"value": np.float32(1.0)})]
    prev = "data"
    for i in range(depth):
        nodes.append(NodeDef(name=f"n{i}", op="Add", inputs=[prev, "c"]))
        prev = f"n{i}"
    net = GraphNet(GraphDef(name="chain", nodes=nodes), device="cpu")
    assert net.output_names() == [prev]
    out = net.forward({"data": np.zeros((2, 4), np.float32)}, [prev])
    np.testing.assert_allclose(out[prev], float(depth))


def test_the_graph_net_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphNet(build_mnist_graph(batch=4))
