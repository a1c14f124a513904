"""Graph construction API + reference-model generators.

A copy of `sparknet_tpu/backend/builder.py` for the port (pure numpy; the
copy imports the port's `graphdef`): the same seed builds the same
GraphDef, byte for byte in JSON, in either package.

The reference generated its serialized TF graphs with Python scripts
(`models/tensorflow/mnist/mnist_graph.py`, `alexnet/alexnet_graph.py`) that
end by injecting, for every Variable, `<name>//update_placeholder` +
`<name>//assign` nodes plus `init//all_vars` and `train//step`. The builder
reproduces that protocol for our portable GraphDef JSON.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .graphdef import (ASSIGN_SUFFIX, GraphDef, INIT_ALL_VARS, NodeDef,
                       TRAIN_STEP, UPDATE_SUFFIX)


class GraphBuilder:
    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: List[NodeDef] = []
        self._names: set = set()

    def _add(self, name: str, op: str, inputs: Sequence[str] = (),
             **attrs: Any) -> str:
        if name in self._names:
            raise ValueError(f"duplicate node name {name!r}")
        self._names.add(name)
        self.nodes.append(NodeDef(name=name, op=op, inputs=list(inputs),
                                  attrs=attrs))
        return name

    def placeholder(self, name: str, shape, dtype: str = "float32") -> str:
        return self._add(name, "Placeholder", shape=list(shape), dtype=dtype)

    def variable(self, name: str, init: np.ndarray) -> str:
        return self._add(name, "Variable", init=np.asarray(init, np.float32),
                         shape=list(np.shape(init)))

    def conv2d(self, name, x, w, stride=1, padding="SAME", groups=1) -> str:
        return self._add(name, "Conv2D", [x, w], strides=[stride, stride],
                         padding=padding, groups=groups)

    def bias_add(self, name, x, b) -> str:
        return self._add(name, "BiasAdd", [x, b])

    def relu(self, name, x) -> str:
        return self._add(name, "Relu", [x])

    def max_pool(self, name, x, ksize=2, strides=2, padding="SAME") -> str:
        return self._add(name, "MaxPool", [x], ksize=ksize, strides=strides,
                         padding=padding)

    def flatten(self, name, x) -> str:
        return self._add(name, "Flatten", [x])

    def matmul(self, name, x, w) -> str:
        return self._add(name, "MatMul", [x, w])

    def add(self, name, a, b) -> str:
        return self._add(name, "Add", [a, b])

    def softmax(self, name, x) -> str:
        return self._add(name, "Softmax", [x])

    def sparse_softmax_ce(self, name, logits, labels) -> str:
        return self._add(name, "SparseSoftmaxCrossEntropy", [logits, labels])

    def accuracy(self, name, logits, labels) -> str:
        return self._add(name, "Accuracy", [logits, labels])

    def finalize(self, loss: Optional[str] = None, learning_rate: float = 0.01,
                 momentum: float = 0.9, lr_policy: str = "fixed",
                 decay_rate: Optional[float] = None,
                 decay_steps: Optional[float] = None,
                 staircase: bool = True) -> GraphDef:
        """Inject the update/assign/init/train protocol nodes (the reference
        generators' final block) and return the GraphDef.

        lr_policy="exp_decay" declares an in-graph schedule
        lr(it) = learning_rate * decay_rate^(it/decay_steps) (floored when
        staircase), matching the reference mnist graph's
        tf.train.exponential_decay optimizer block."""
        variables = [n.name for n in self.nodes if n.op == "Variable"]
        for v in variables:
            shape = self.nodes[[n.name for n in self.nodes].index(v)].attrs[
                "shape"]
            self._add(v + UPDATE_SUFFIX, "Placeholder", shape=shape,
                      dtype="float32")
            self._add(v + ASSIGN_SUFFIX, "Assign",
                      [v, v + UPDATE_SUFFIX])
        self._add(INIT_ALL_VARS, "NoOp", [])
        if loss is not None:
            attrs = dict(learning_rate=learning_rate, momentum=momentum,
                         lr_policy=lr_policy)
            if lr_policy == "exp_decay":
                if decay_rate is None or decay_steps is None:
                    raise ValueError(
                        "exp_decay needs decay_rate and decay_steps")
                attrs.update(decay_rate=decay_rate, decay_steps=decay_steps,
                             staircase=staircase)
            elif lr_policy != "fixed":
                raise ValueError(f"unknown lr_policy {lr_policy!r}")
            self._add(TRAIN_STEP, "Train", [loss], **attrs)
        return GraphDef(name=self.name, nodes=self.nodes)


def build_alexnet_graph(batch: int = 256, n_classes: int = 1000,
                        seed: int = 0, learning_rate: float = 0.01,
                        momentum: float = 0.9) -> GraphDef:
    """AlexNet graph with in-graph Momentum(0.01, 0.9) — same architecture
    and optimizer as the reference's `alexnet_graph.py` generator (the graph
    `TFImageNetApp.scala:80-84` trained): 227x227x3 input; conv 11x11/4
    SAME ->57 (the reference pb's conv1 is SAME: (128,57,57,64)), pool3/2
    ->28, conv 5x5 SAME, pool3/2 ->13, 3x conv 3x3 SAME, pool3/2 ->6,
    fc 9216->4096->4096->n_classes; fixed-lr Momentum (that generator used
    no lr schedule, unlike the mnist one)."""
    r = np.random.default_rng(seed)

    def w(shape, std=0.01):
        return std * r.standard_normal(shape)

    g = GraphBuilder("alexnet")
    g.placeholder("data", (batch, 227, 227, 3))
    g.placeholder("label", (batch,), dtype="int32")
    chans = [(11, 3, 64, 4, "SAME"), (5, 64, 192, 1, "SAME"),
             (3, 192, 384, 1, "SAME"), (3, 384, 256, 1, "SAME"),
             (3, 256, 256, 1, "SAME")]
    x = "data"
    for i, (k, cin, cout, stride, pad) in enumerate(chans, start=1):
        g.variable(f"conv{i}_w", w((k, k, cin, cout)))
        g.variable(f"conv{i}_b", np.zeros(cout))
        x = g.conv2d(f"conv{i}", x, f"conv{i}_w", stride=stride, padding=pad)
        x = g.bias_add(f"conv{i}_biased", x, f"conv{i}_b")
        x = g.relu(f"relu{i}", x)
        if i in (1, 2, 5):
            x = g.max_pool(f"pool{i}", x, ksize=3, strides=2,
                           padding="VALID")
    f = g.flatten("flat", x)  # 6*6*256 = 9216
    g.variable("fc6_w", w((9216, 4096)))
    g.variable("fc6_b", 0.1 * np.ones(4096))
    h = g.relu("relu6", g.add("fc6_biased", g.matmul("fc6", f, "fc6_w"),
                              "fc6_b"))
    g.variable("fc7_w", w((4096, 4096)))
    g.variable("fc7_b", 0.1 * np.ones(4096))
    h = g.relu("relu7", g.add("fc7_biased", g.matmul("fc7", h, "fc7_w"),
                              "fc7_b"))
    g.variable("fc8_w", w((4096, n_classes)))
    g.variable("fc8_b", np.zeros(n_classes))
    logits = g.add("logits", g.matmul("fc8", h, "fc8_w"), "fc8_b")
    g.softmax("prob", logits)
    g.accuracy("accuracy", logits, "label")
    loss = g.sparse_softmax_ce("loss", logits, "label")
    return g.finalize(loss=loss, learning_rate=learning_rate,
                      momentum=momentum, lr_policy="fixed")


def build_mnist_graph(batch: int = 64, seed: int = 66478,
                      learning_rate: float = 0.01,
                      train_size: int = 60000) -> GraphDef:
    """LeNet-style MNIST convnet graph — mirrors the reference's
    `mnist_graph.py` architecture (conv5x5x32 SAME + pool2, conv5x5x64 SAME +
    pool2, fc512, fc10) and its Momentum optimizer INCLUDING the in-graph
    exponential_decay(0.01, it*batch, train_size, 0.95, staircase) lr
    schedule — expressed as Train-node attrs with decay_steps in iteration
    units (train_size/batch iters per decay = identical lr(it) curve)."""
    r = np.random.default_rng(seed)
    g = GraphBuilder("mnist")
    g.placeholder("data", (batch, 28, 28, 1))
    g.placeholder("label", (batch, 1), dtype="int32")
    g.variable("conv1_w", (0.1 * r.standard_normal((5, 5, 1, 32))))
    g.variable("conv1_b", np.zeros(32))
    g.variable("conv2_w", (0.1 * r.standard_normal((5, 5, 32, 64))))
    g.variable("conv2_b", 0.1 * np.ones(64))
    g.variable("fc1_w", (0.1 * r.standard_normal((7 * 7 * 64, 512))))
    g.variable("fc1_b", 0.1 * np.ones(512))
    g.variable("fc2_w", (0.1 * r.standard_normal((512, 10))))
    g.variable("fc2_b", 0.1 * np.ones(10))
    c1 = g.conv2d("conv1", "data", "conv1_w")
    c1 = g.bias_add("conv1_biased", c1, "conv1_b")
    c1 = g.relu("relu1", c1)
    p1 = g.max_pool("pool1", c1)
    c2 = g.conv2d("conv2", p1, "conv2_w")
    c2 = g.bias_add("conv2_biased", c2, "conv2_b")
    c2 = g.relu("relu2", c2)
    p2 = g.max_pool("pool2", c2)
    f = g.flatten("flat", p2)
    h = g.relu("relu3", g.add("fc1_biased", g.matmul("fc1", f, "fc1_w"),
                              "fc1_b"))
    logits = g.add("logits", g.matmul("fc2", h, "fc2_w"), "fc2_b")
    g.softmax("prob", logits)
    g.accuracy("accuracy", logits, "label")
    loss = g.sparse_softmax_ce("loss", logits, "label")
    return g.finalize(loss=loss, learning_rate=learning_rate, momentum=0.9,
                      lr_policy="exp_decay", decay_rate=0.95,
                      decay_steps=train_size / batch, staircase=True)
