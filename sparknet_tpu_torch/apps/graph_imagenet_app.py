"""ImageNet training on the SERIALIZED-GRAPH backend — the counterpart of
`sparknet_tpu/apps/graph_imagenet_app.py` (the reference's
`apps/TFImageNetApp.scala`): an AlexNet graph with its in-graph Momentum
optimizer trained inside the distributed τ-averaging loop (batch 256, τ=10,
eval every 10), fed by the sharded-tar ImageNet ingest with mean-subtract,
random crop and CHW->HWC preprocessing.

The graph can be:
  - (default) the portable generator `build_alexnet_graph()`;
  - `--graph path.pb` — a frozen TF GraphDef, trained through its imported
    in-graph optimizer;
  - `--graph path.json` — a portable GraphDef JSON produced elsewhere.

Corpus modes (cache vs stream) and several machines are shared with
`imagenet_app`: the same --stream / --ram-budget-mb / --val-limit knobs.

Usage (one process per card):

    python -m sparknet_tpu_torch.apps.graph_imagenet_app --data-dir DIR \\
        [--graph g.json|g.pb] [--device cpu] [key=value ...]
"""
from __future__ import annotations

import argparse
import functools

from ..backend import build_alexnet_graph
from ..parallel.mesh import init_data_group
from ..utils.config import RunConfig
from .graph_common import load_graph, train_graph
from .imagenet_app import add_data_args, prepare_data


def default_config() -> RunConfig:
    return RunConfig(model="graph:alexnet", n_classes=1000,
                     data_dir="data/imagenet", crop=227, tau=10,
                     local_batch=256, eval_every=10, max_rounds=1000)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--graph", default=None,
                   help=".pb (TF GraphDef) or .json (portable) graph file")
    add_data_args(p)
    p.add_argument("--device", default=None,
                   help="cuda (default: this rank's card) or cpu")
    args = p.parse_args(argv)
    cfg = (RunConfig.from_json(args.config) if args.config
           else default_config())
    if args.data_dir:
        cfg.data_dir = args.data_dir
    cfg = cfg.with_overrides(*args.overrides)
    # the group comes first: the mean image and the eval agreement are
    # collective (train_graph joins the same group)
    group = init_data_group(args.device, workdir=cfg.workdir)
    try:
        # label_shape=() -> (B,) flat int labels (the TF-graph convention;
        # the Caffe path uses (1,) -> (B,1))
        train_raw, test_ds, pp_train, pp_eval, _ = prepare_data(
            cfg, args, label_shape=(), app_name="graph_imagenet_app",
            group=group)
        try:
            graph = load_graph(args.graph, functools.partial(
                build_alexnet_graph, batch=cfg.local_batch,
                n_classes=cfg.n_classes))
            crop = cfg.crop or 227
            train_graph(cfg, graph, train_raw, test_ds,
                        batch_transform=pp_train, eval_transform=pp_eval,
                        expect_data_shape=(crop, crop, 3),
                        device=args.device)
        finally:
            if hasattr(train_raw, "close"):
                train_raw.close()
    finally:
        group.close()


if __name__ == "__main__":
    main()
