"""MNIST training app — the counterpart of `sparknet_tpu/apps/mnist_app.py`
(reference `apps/MnistApp.scala`): LeNet.

Reference defaults: batch 64, τ=10, eval every 5 rounds, Momentum(0.01
exp-decay, 0.9) (`MnistApp.scala:18,118`; `models/tensorflow/mnist/
mnist_graph.py` optimizer block: lr = 0.01 * 0.95^(epoch)). The exp-decay is
expressed with the solver's `exp` policy: gamma^iter with gamma chosen so one
epoch (train_size/batch iters) decays by 0.95.

Usage (one process per card; every rank loads the whole set and keeps its
machine's slice, which the loop's sampler splits over the machine's ranks):

    python -m sparknet_tpu_torch.apps.mnist_app --data-dir data/mnist \\
        [--device cpu] [--config run.json] [key=value ...]
"""
from __future__ import annotations

import argparse

from ..data.dataset import ArrayDataset
from ..data.mnist import MnistLoader
from ..parallel.mesh import machine_topology
from ..solver import SolverConfig
from ..utils.config import RunConfig
from .train_loop import resolve_spec, train


def default_config(train_size: int = 60000) -> RunConfig:
    iters_per_epoch = max(train_size // 64, 1)
    gamma = 0.95 ** (1.0 / iters_per_epoch)
    return RunConfig(
        model="lenet",
        solver=SolverConfig(base_lr=0.01, momentum=0.9, lr_policy="exp",
                            gamma=gamma),
        data_dir="data/mnist", tau=10, local_batch=64,
        eval_every=5, max_rounds=100)


def build_datasets(cfg: RunConfig):
    loader = MnistLoader(cfg.data_dir)
    return (ArrayDataset(loader.train_batch_dict()),
            ArrayDataset(loader.test_batch_dict()))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", help="RunConfig JSON path")
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
    train_ds, test_ds = build_datasets(cfg)
    m, pc, _, _ = machine_topology()
    train_ds, test_ds = train_ds.host_shard(m, pc), test_ds.host_shard(m, pc)
    spec = resolve_spec(cfg, data=(cfg.local_batch, 1, 28, 28),
                        label=(cfg.local_batch, 1))
    train(cfg, spec, train_ds, test_ds, device=args.device)


if __name__ == "__main__":
    main()
