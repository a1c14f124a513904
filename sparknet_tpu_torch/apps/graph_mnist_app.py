"""MNIST training on the SERIALIZED-GRAPH backend — the counterpart of
`sparknet_tpu/apps/graph_mnist_app.py` (the reference's `apps/MnistApp.
scala` pairing): a TensorFlowNet-style graph (in-graph Momentum optimizer
and exp-decay lr) trained inside the distributed τ-averaging loop (batch
64, τ=10, eval every 5).

The graph can be:
  - (default) the portable generator `build_mnist_graph()`;
  - `--graph path.json` — a portable GraphDef JSON produced elsewhere;
  - `--graph path.pb` — a frozen TF GraphDef, trained through its imported
    in-graph optimizer.

Usage (one process per card):

    python -m sparknet_tpu_torch.apps.graph_mnist_app --data-dir data/mnist \\
        [--graph g.json|g.pb] [--device cpu] [key=value ...]
"""
from __future__ import annotations

import argparse
import functools

import numpy as np

from ..backend import build_mnist_graph
from ..data.dataset import ArrayDataset
from ..data.mnist import MnistLoader
from ..parallel.mesh import machine_topology
from ..utils.config import RunConfig
from .graph_common import load_graph, train_graph


def default_config() -> RunConfig:
    return RunConfig(model="graph:mnist", data_dir="data/mnist", tau=10,
                     local_batch=64, eval_every=5, eval_batch=512,
                     max_rounds=100)


def _nhwc(arrays):
    """The loader emits Caffe NCHW; the graph backend is NHWC."""
    out = dict(arrays)
    out["data"] = np.ascontiguousarray(
        np.transpose(arrays["data"], (0, 2, 3, 1)))
    out["label"] = arrays["label"].reshape(-1)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", help="RunConfig JSON path")
    p.add_argument("--graph", default=None,
                   help=".pb (TF GraphDef) or .json (portable) graph file")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (default: this rank's card) or cpu")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    cfg = (RunConfig.from_json(args.config) if args.config
           else default_config())
    if args.data_dir:
        cfg.data_dir = args.data_dir
    cfg = cfg.with_overrides(*args.overrides)
    loader = MnistLoader(cfg.data_dir)
    train_ds = ArrayDataset(_nhwc(loader.train_batch_dict()))
    test_ds = ArrayDataset(_nhwc(loader.test_batch_dict()))
    m, pc, _, _ = machine_topology()
    train_ds, test_ds = train_ds.host_shard(m, pc), test_ds.host_shard(m, pc)
    graph = load_graph(args.graph, functools.partial(
        build_mnist_graph, batch=cfg.local_batch, train_size=len(train_ds)))
    train_graph(cfg, graph, train_ds, test_ds,
                expect_data_shape=(28, 28, 1), device=args.device)


if __name__ == "__main__":
    main()
