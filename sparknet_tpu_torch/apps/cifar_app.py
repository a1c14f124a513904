"""CIFAR-10 training app — the counterpart of `sparknet_tpu/apps/cifar_app.py`
(reference `apps/CifarApp.scala`).

Reference defaults preserved: batch 100, τ=10, eval every 5 rounds, solver
lr 0.001 fixed / momentum 0.9 / weight decay 0.004
(`CifarApp.scala:20,127,107`; `models/cifar10/cifar10_quick_solver.prototxt`).

Usage (one process per card; a plain launch is a world of one). Every rank
loads the whole set and keeps its machine's slice (`host_shard` by
`machine_topology`, as the JAX app keeps its host's); the loop's sampler
splits that slice over the machine's ranks:

    python -m sparknet_tpu_torch.apps.cifar_app --data-dir data/cifar10 \\
        [--device cpu] [--config run.json] [key=value ...]
    torchrun --nproc-per-node 4 -m sparknet_tpu_torch.apps.cifar_app ...

Exit code 75 is an elastic membership change (`ElasticRelaunch`, a
SystemExit the loop raises at the τ boundary): relaunch at the new
world size with `resume=true`.
"""
from __future__ import annotations

import argparse

from ..data.cifar import CifarLoader
from ..data.dataset import ArrayDataset
from ..parallel.mesh import machine_topology
from ..solver import SolverConfig
from ..utils.config import RunConfig
from .train_loop import resolve_spec, train


def default_config() -> RunConfig:
    return RunConfig(
        model="cifar10_quick",
        solver=SolverConfig(base_lr=0.001, momentum=0.9, weight_decay=0.004,
                            lr_policy="fixed", max_iter=4000),
        data_dir="data/cifar10", tau=10, local_batch=100,
        eval_every=5, max_rounds=100)


def build_datasets(cfg: RunConfig):
    loader = CifarLoader(cfg.data_dir, seed=cfg.seed)
    return (ArrayDataset(loader.train_batch_dict(cfg.subtract_mean)),
            ArrayDataset(loader.test_batch_dict(cfg.subtract_mean)))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", help="RunConfig JSON path")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (default: this rank's card) or cpu")
    p.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = p.parse_args(argv)
    cfg = (RunConfig.from_json(args.config) if args.config
           else default_config())
    if args.data_dir:
        cfg.data_dir = args.data_dir
    cfg = cfg.with_overrides(*args.overrides)
    train_ds, test_ds = build_datasets(cfg)
    # every rank loads identically, then keeps its machine's disjoint
    # slice (the reference's repartition + per-executor cache)
    m, pc, _, _ = machine_topology()
    train_ds, test_ds = train_ds.host_shard(m, pc), test_ds.host_shard(m, pc)
    spec = resolve_spec(cfg, data=(cfg.local_batch, 3, 32, 32),
                        label=(cfg.local_batch, 1))
    train(cfg, spec, train_ds, test_ds, device=args.device)


if __name__ == "__main__":
    main()
