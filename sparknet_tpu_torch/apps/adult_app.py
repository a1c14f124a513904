"""Adult/Census tabular app — the counterpart of
`sparknet_tpu/apps/adult_app.py` (reference test-fixture workload:
`models/adult/adult.prototxt` + `LoadAdultDataSpec.scala`), extended to a
trainable 2-class MLP. The last 20% of the rows are the held-out eval.

Usage (one process per card; every rank loads the whole CSV and keeps its
machine's slice, which the loop's sampler splits over the machine's ranks):

    python -m sparknet_tpu_torch.apps.adult_app --data adult.data \\
        [--device cpu] [key=value ...]
"""
from __future__ import annotations

import argparse

from ..data.adult import AdultLoader
from ..data.dataset import ArrayDataset
from ..model.spec import Filler, InputSpec, NetSpec
from ..parallel.mesh import machine_topology
from ..solver import SolverConfig
from ..utils.config import RunConfig
from ..zoo import _heads, _ip, _relu
from .train_loop import train


def adult_net(batch: int, n_features: int) -> NetSpec:
    """adult.prototxt's MLP with a loss/accuracy head for training."""
    return NetSpec(
        name="adult",
        inputs=(InputSpec("C0", (batch, n_features)),
                InputSpec("label", (batch, 1), "int32")),
        layers=(
            _ip("ip", "C0", 10, filler=Filler(type="xavier")),
            _relu("relu", "ip"),
            _ip("ip2", "ip", 2, filler=Filler(type="xavier")),
        ) + _heads("ip2"),
    )


def default_config() -> RunConfig:
    return RunConfig(
        model="adult",
        solver=SolverConfig(base_lr=0.01, momentum=0.9, lr_policy="fixed"),
        tau=5, local_batch=64, eval_every=5, max_rounds=50)


def build_datasets(path: str):
    """(train_ds, test_ds, n_features): the first 80% of the rows train,
    the rest evaluate (the reference's adult path had no eval at all)."""
    loader = AdultLoader(path)
    full = loader.batch_dict()
    split = max(1, int(len(loader.labels) * 0.8))
    return (ArrayDataset({k: v[:split] for k, v in full.items()}),
            ArrayDataset({k: v[split:] for k, v in full.items()}),
            loader.features.shape[1])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="adult.data CSV path")
    p.add_argument("--device", default=None,
                   help="cuda (default: this rank's card) or cpu")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    cfg = default_config().with_overrides(*args.overrides)
    train_ds, test_ds, n_features = build_datasets(args.data)
    m, pc, _, _ = machine_topology()
    train_ds, test_ds = train_ds.host_shard(m, pc), test_ds.host_shard(m, pc)
    train(cfg, adult_net(cfg.local_batch, n_features), train_ds, test_ds,
          device=args.device)


if __name__ == "__main__":
    main()
